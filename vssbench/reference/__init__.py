"""The benchmark's plain reference: a frozen copy of the codec's
arithmetic and blob format, and of a view read's cut and box mean.
It imports nothing of the program."""
