"""Scripted drivers: PID controllers, the LocalPlanner and the GPS-space
expert."""
