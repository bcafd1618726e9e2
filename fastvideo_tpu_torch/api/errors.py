"""Typed config errors (port of fastvideo_tpu/api/errors.py)."""

from __future__ import annotations


class ConfigValidationError(ValueError):
    """Validation error carrying the nested config path."""

    def __init__(self, path: str, message: str):
        self.path = path
        self.message = message
        super().__init__(str(self))

    def __str__(self) -> str:
        return f"{self.path}: {self.message}" if self.path else self.message


class UnknownFieldError(ConfigValidationError):
    pass
