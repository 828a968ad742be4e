"""Video and image-list readers of the port (its own copies)."""
