"""The port's PRG (ChaCha, bit-identical to the reference) and word packing."""
