"""Kellogg's intersecting-interfaces operator in the box scheme
(``reference/kellogg.py``): the benchmark makes its f64 planes from the
reference's frozen copy and hands them to the solver (``planes``); the
reference applies the same planes in f64, so ``correct`` holds the
program's answer to the exact operator."""

from portbench.reference import kellogg


def inputs(config: dict, device) -> dict:
    side = int(config["solver"]["side"])
    return {"planes": kellogg.planes(kellogg.cells(side, device))}


def reference_apply(config: dict, inputs: dict):
    c = inputs["planes"]
    return lambda u: kellogg.planes_apply(c, u)
