"""LM training: the train step, the fault-tolerant loop and its stats."""
