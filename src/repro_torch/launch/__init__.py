"""Step builders and the batch server of the port."""
