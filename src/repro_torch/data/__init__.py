from repro_torch.data.pipeline import SyntheticPipeline, make_batch  # noqa: F401
