"""PLY, PNG and JPEG I/O, PIL's default resize and the HTTP viewer."""
