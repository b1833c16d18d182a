"""Catalog index and the Retriever API."""
