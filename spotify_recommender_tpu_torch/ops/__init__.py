"""Oracle scoring, top-k merges and the certified exact tier."""
