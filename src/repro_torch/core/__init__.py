"""Campaign specs, the planner and the torch sweep engine."""
