from fastvideo_tpu_torch.workflow.workflow_base import WorkflowBase

__all__ = ["WorkflowBase"]
