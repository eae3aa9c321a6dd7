"""The plain reference the program's answers are held against."""
