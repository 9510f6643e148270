"""The 5-point finite-difference Laplacian of the reference's test problem
(grid.hpp:88-98): the solver builds it itself from the side, so the
benchmark hands it nothing, and the reference applies its own f64 copy."""

from portbench.reference import operators


def inputs(config: dict, device) -> dict:
    return {}


def reference_apply(config: dict, inputs: dict):
    return operators.poisson5_apply
