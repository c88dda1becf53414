"""The plain reference: what the program derives, worked out again in
plain numpy and torch from the inputs the benchmark hands to both sides.
It imports nothing of the program."""
