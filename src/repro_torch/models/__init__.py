"""Model definitions of the port (dense decoders)."""
