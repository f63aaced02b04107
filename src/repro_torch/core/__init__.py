"""Float Goldschmidt datapath: ROM tables, the bit-peel ops, the policy."""
