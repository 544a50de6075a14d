"""Developer tools of the port: card parity of the tile kernels against the
scan blend (`parity`), and the multi-rank work table (`scaling_table`)."""
