"""The plain reference: WordCount in numpy and Python, written from the
configuration's stated semantics.  It imports nothing of the port and
reads nothing the port made."""
