"""Ackley's function (Ackley 1987; the TuRBO paper's Ackley-10D, Eriksson
et al. 2019): −20 exp(−0.2 √mean(x²)) − exp(mean cos 2πx) + 20 + e, in
float64."""

import math

import torch


def evaluate(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float64)
    s1 = torch.sqrt((x * x).mean(dim=-1))
    s2 = torch.cos(2.0 * math.pi * x).mean(dim=-1)
    return -20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e
