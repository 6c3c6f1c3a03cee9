"""Dataset metadata and the writer."""
