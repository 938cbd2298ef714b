"""Stage 3 of the pipeline: shell (base mesh) extraction."""
