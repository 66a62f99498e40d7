"""The H100 benchmark of jegal_torch (see README.md)."""
