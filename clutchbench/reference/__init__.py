"""The plain reference: the queries' and the forest's semantics in plain
PyTorch, worked out again from the inputs the harness made.  It imports
nothing of the program."""
