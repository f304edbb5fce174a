"""The synthetic training data of the port's LM stack (`pipeline`)."""
