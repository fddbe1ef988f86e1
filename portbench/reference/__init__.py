"""The plain reference that decides ``correct``.

Plain NumPy and torch only: it imports neither the program under test nor
the JAX package.  :mod:`.container` reads the SZ3J container format from the
bytes alone; :mod:`.sz3_bound` derives the absolute error bound again from
the input and judges each decoded field and blob against it.
"""
