"""The plain reference: softened Newtonian gravity by direct summation and
kick-drift-kick leapfrog, in plain PyTorch, in whatever precision it is
given (float64 for the comparison). It imports nothing of the program."""
