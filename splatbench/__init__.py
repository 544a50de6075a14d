"""The benchmark of tpu_splat_torch: one command runs one cell once
(`python3 -m splatbench.run`); see README.md."""
