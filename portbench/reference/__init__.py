"""The plain reference: NumPy and Python, importing nothing of the
program. Each module answers one kind of query from the benchmark's own
plain data (portbench/gen.py) by the semantics the configuration states,
and offers a control: the same reference with one stated guarantee
broken, which the comparison has to find wrong."""
