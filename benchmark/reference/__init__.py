"""The benchmark's plain reference of the search that ``correct`` is judged by.

Plain NumPy and PyTorch, written from the definition of the search (the
Sassy papers' semi-global edit distance, rightmost local minima as match
ends, a greedy backwards traceback). It imports nothing of the program
under test and reads nothing the program made: only the generated texts
and patterns, k and the strands.
"""
