"""Shared code of the benchmark: the spec, the traffic generator, the
plain reference, the trace reader and the result line."""
