"""Shared utilities: paths, logging, file copies, mounts, .dockerignore."""
