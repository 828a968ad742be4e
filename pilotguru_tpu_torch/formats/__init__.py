"""Host file formats the port reads and writes (its own copies)."""
