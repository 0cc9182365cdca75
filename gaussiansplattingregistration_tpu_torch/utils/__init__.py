"""PLY codec, cloud IO, PNG writer and device selection."""
