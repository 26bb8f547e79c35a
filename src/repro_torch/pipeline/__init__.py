from repro_torch.pipeline.executor import PipelineExecutor, StepResult  # noqa: F401
