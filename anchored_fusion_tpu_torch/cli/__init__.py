"""Command-line drivers mirroring the reference CLIs."""
