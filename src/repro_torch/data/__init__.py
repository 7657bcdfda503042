from repro_torch.data.pipeline import (SyntheticCorpus, batch_iterator,
                                       continuation_task)

__all__ = ["SyntheticCorpus", "batch_iterator", "continuation_task"]
