"""Flag parsing, weights, checkpoints and the train state, logging."""
