"""The row-sharded catalog and the multi-process bootstrap."""
