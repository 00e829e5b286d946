"""One module per way of driving the program through the window, found by
a traffic file's ``entry``. Each has an ``Entry`` class (see
``portbench.harness`` for what it offers); the traffic file's other keys
are that entry's parameters."""
