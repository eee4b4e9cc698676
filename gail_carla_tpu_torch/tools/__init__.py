"""Command-line tools of the demo-file and behaviour-cloning recipe:
``gen_trajectories`` (export demos as a ``gail_experts/`` PNG tree),
``expert_dataset`` (load one), ``learn_bc`` and ``evaluation``."""
