"""Evaluation of the port: CTC decoding and CER, Fréchet distances (rFID),
and the per-epoch export gate."""
