"""Training-loop support: step-numbered checkpoints (`checkpoint`)."""
