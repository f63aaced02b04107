"""Greedy sampling through the Goldschmidt softmax.

As in the reference (``repro.serving.sampler``), the greedy token is the
argmax of ``policy.softmax(logits)``, not of the logits: under a seed-only
policy two close logits can round to the same probability, and then the
first index wins, as it does in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import NumericsPolicy


def sample_greedy(logits: torch.Tensor, *, policy: NumericsPolicy) -> torch.Tensor:
    """logits (b, V) -> (b,) int32 token ids."""
    probs = policy.softmax(logits.to(torch.float32), dim=-1)
    return torch.argmax(probs, dim=-1).to(torch.int32)
