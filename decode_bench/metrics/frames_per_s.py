"""Pictures that the window's calls wrote into the device pool, of every
stream, over the window: from the first call's start to the completion,
after a synchronize, of the last call dispatched in it."""


def read(w):
    return w.pictures / w.seconds
