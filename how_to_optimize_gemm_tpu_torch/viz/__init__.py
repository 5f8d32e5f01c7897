from how_to_optimize_gemm_tpu_torch.viz.plot import plot_mfiles  # noqa: F401
