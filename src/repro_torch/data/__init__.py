from repro_torch.data.pipeline import Prefetcher, synthetic_batch, to_device  # noqa: F401,E501
