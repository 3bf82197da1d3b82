"""Serving: the dense-cache continuous-batching engine."""
from .engine import (PromptTooLongError, Request, ServeConfig, ServingEngine,
                     validate_prompt)

__all__ = ["PromptTooLongError", "Request", "ServeConfig", "ServingEngine",
           "validate_prompt"]
