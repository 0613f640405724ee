from repro_torch.data.pipeline import (
    SyntheticTokenDataset,
    make_lm_batch_iterator,
)

__all__ = ["SyntheticTokenDataset", "make_lm_batch_iterator"]
