"""Asset ingestion: mesh files and scene files (numpy and the native
core; no JAX)."""
