"""Command-line tools: the demo-file and behaviour-cloning recipe
(``gen_trajectories`` exports demos as a ``gail_experts/`` PNG tree,
``expert_dataset`` loads one, ``learn_bc``, ``evaluation``) and the policy
benchmarks (``benchmark_policy``, ``nocrash_bench``, ``corl_bench``), and
two host tools: ``export_map`` (an H5 map pack of a grid town; needs
``h5py``) and ``plot_results`` (training curves from ``metrics.jsonl``;
needs ``matplotlib``)."""
