"""PLY and PNG I/O and the HTTP viewer."""
