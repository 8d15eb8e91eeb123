"""Trainers (supervised, adversarial), optimizers and the eval loop."""
