from .plan import ParallelPlan, single_device_plan

__all__ = ["ParallelPlan", "single_device_plan"]
