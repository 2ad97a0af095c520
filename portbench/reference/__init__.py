"""The plain reference: texts worked out again from the generated
changes, in plain Python and NumPy. It imports nothing of the program
and takes nothing the program made."""
