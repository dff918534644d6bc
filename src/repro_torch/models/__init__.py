"""Decoder LMs: layers and model composition."""
