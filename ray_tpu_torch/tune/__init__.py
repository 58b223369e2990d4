"""Tune: the Trainable that RLlib's algorithms subclass."""
