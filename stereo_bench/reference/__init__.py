"""The plain reference the benchmark judges the program's outputs against."""
