"""Rollout collection and deterministic evaluation."""
