"""Runtime precision policies and the precision scope (port of
``repro.runtime``)."""

from .context import current_precision, precision_scope
from .policy import (AdaptiveBudget, Fixed, PerLayerSchedule, PolicyFeedback,
                     PrecisionPolicy)

__all__ = ["AdaptiveBudget", "Fixed", "PerLayerSchedule", "PolicyFeedback",
           "PrecisionPolicy", "current_precision", "precision_scope"]
