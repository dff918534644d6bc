"""The plain reference: the queries', the forest's and each language
model's semantics in plain PyTorch, worked out again from the inputs the
harness made.  It imports nothing of the program."""
