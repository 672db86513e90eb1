"""Cost model, dispatcher counters and reports of the port's dry run."""
