"""Clean twin of contract010_violation.py: registered kinds, and calls of
other shapes that the rule leaves alone."""
import logging
import math


def registered(tel, rec, step, loss):
    tel.log("train", step, loss=loss)
    rec.emit("span", step, name="train_step", ms=1.0)
    logging.getLogger(__name__).log(logging.INFO, "step %d", step)
    return math.log(2.0)
