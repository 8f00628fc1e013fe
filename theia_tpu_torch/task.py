"""Reference-name alias: the reference keeps its dynamic-task layer in
``theia.task`` (reference: src/theia/task.py); here those live in
:mod:`theia_tpu_torch.pipeline`, as in ``theia_tpu``. This module keeps
``from theia_tpu_torch.task import ConvergeHistogramTask`` working."""

from .pipeline import (  # noqa: F401
    ConvergeHistogramTask,
    DynamicTask,
    Pipeline,
    PipelineScheduler,
    runPipeline,
)

__all__ = [
    "ConvergeHistogramTask",
    "DynamicTask",
    "Pipeline",
    "PipelineScheduler",
    "runPipeline",
]
