"""Unit kinds: ``portbench/kinds/<unit>.py`` holds the ``Unit`` class of
the kind that a traffic file's ``unit`` names (see
:mod:`portbench.units`)."""
