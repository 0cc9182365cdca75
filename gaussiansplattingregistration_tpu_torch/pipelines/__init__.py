"""End-to-end pipelines of the torch port."""
