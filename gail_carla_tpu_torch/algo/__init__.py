"""Rollout collection, evaluation, the observation store and the WDGAIL
training update (critic, PPO, optimizers, learner)."""
