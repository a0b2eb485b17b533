"""Genome k-mer index split into shards (one device; the mesh is not
ported yet)."""
