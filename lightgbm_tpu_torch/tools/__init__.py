"""Developer tooling that ships with the port (static analysis).  Nothing
here is imported by the runtime library."""
