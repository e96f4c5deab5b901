"""One driver per traffic kind (a traffic file's ``kind``): ``run(ctx)``
sets the cell up, runs the measured window, frees the program's state,
checks the answers and returns the record the harness reports."""
