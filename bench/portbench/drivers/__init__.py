"""One driver per kind of traffic. A driver builds the cell from its
configuration and mix (``setup``), runs the window through the port's
entry (``run_window``), gives the end-to-end metrics over the whole window
(``end_to_end``), frees the program's state (``release``) and checks what
the window produced against the plain reference (``check``)."""
