"""Operators: attention, dropout and the optimizers of the port, and the
host-native ops (`op_builder`: the CPU Adam and the aio engine)."""
