"""Evaluation loop (training is still to be ported, ROADMAP.md)."""
