"""Plain references, one file per configuration, and the math they
share.  They import nothing of the program."""
