"""Feature schema, CSV ingest, normalization and the catalog artifact."""
