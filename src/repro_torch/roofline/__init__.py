"""Roofline of the port's steps: per-op costs from shape-only traces
(`op_costs`), the three roofline terms at the card's rates
(`analysis`), saved traces re-derived (`reanalyze`) and the report
(`report`)."""
