"""The general generators: a traffic file's ``driver`` names one of these
modules, which builds the configuration's program, drives it by the file's
parameters and checks what it produced against the plain reference."""
