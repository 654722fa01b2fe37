from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator

__all__ = ["SyntheticLMData", "make_batch_iterator"]
