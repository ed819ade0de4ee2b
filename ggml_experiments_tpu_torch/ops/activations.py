"""Elementwise activations by name. ``sigmoid`` is the true logistic function
and ``silu(x) = x * sigmoid(x)``."""

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "silu": silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": torch.nn.functional.gelu,
    None: lambda x: x,
    "none": lambda x: x,
    "linear": lambda x: x,
}


def get_activation(name):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None
