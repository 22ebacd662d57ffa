from repro_torch.data.pipeline import DataPipeline, make_pipeline

__all__ = ["DataPipeline", "make_pipeline"]
