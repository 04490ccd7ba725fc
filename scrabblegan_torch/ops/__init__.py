"""Building blocks of the port: SN layers, blocks, filter bank, attention."""
