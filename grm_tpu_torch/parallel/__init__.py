"""Device SCM engines: the exact engine and the argmax grid engine."""
