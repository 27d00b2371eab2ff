"""Stores behind the port's synctree and WAL (only the native store so
far)."""
