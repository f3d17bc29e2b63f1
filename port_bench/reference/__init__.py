"""Plain PyTorch references the benchmark holds the program to. They import
torch and each other, and nothing of the program under test."""
