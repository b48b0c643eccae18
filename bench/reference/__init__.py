"""The plain reference and the numbers that decide correct."""
