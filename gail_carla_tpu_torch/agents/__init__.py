"""Scripted drivers: PID controllers and the LocalPlanner."""
