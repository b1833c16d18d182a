"""Trained models: matrix factorization (`mf`)."""
