from repro_torch.data.pipeline import (Prefetcher, SyntheticLMDataset,
                                       family_extras_fn, make_pipeline)

__all__ = ["SyntheticLMDataset", "Prefetcher", "make_pipeline",
           "family_extras_fn"]
