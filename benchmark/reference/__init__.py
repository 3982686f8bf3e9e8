"""Plain references the benchmark judges the program against. They import
torch and numpy and nothing of the program."""
