"""setup_s: seconds from the process's start to the window's: loading
torch and the program, making the inputs on the card, the kernels' build
(first run in a checkout) or load, and warming the cell's shapes."""
UNIT = "s"
LAYER = "set-up"
SOURCE = "host_clock"


def read(run):
    return run["setup_s"]
