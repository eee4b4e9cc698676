"""Batched simulator: reset and step over an explicit env axis."""
