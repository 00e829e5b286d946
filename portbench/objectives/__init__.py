"""One module per objective, found by the configuration's ``objective``.
Each has ``evaluate(x: Tensor) -> Tensor``: the float64 values of the
points ``x`` (rows, in the configuration's box ``[lb, ub]^dim``)."""
