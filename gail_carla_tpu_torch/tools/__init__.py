"""Command-line tools: the demo-file and behaviour-cloning recipe
(``gen_trajectories`` exports demos as a ``gail_experts/`` PNG tree,
``expert_dataset`` loads one, ``learn_bc``, ``evaluation``) and the policy
benchmarks (``benchmark_policy``, ``nocrash_bench``, ``corl_bench``)."""
