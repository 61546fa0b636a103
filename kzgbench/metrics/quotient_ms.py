"""quotient_ms: the median _eval_form_open span of a workerOpen: the
evaluation-form quotient, batch_inv and the Fr products (ms)."""

from kzgbench import readers

SPANS = [("fourier_tpu_torch.models.piano:_eval_form_open", "quotient")]


def read(run):
    return readers.median_ms(readers.spans(run, "quotient"))
