"""Logging that coexists with tqdm progress bars.

Same observable behaviour as the reference's logging setup
(reference: seqvec_search/utils.py:35-59): log lines are routed through
``tqdm.write`` so in-flight progress bars are not corrupted.
"""

import logging

try:
    import tqdm

    _HAVE_TQDM = True
except Exception:  # pragma: no cover
    _HAVE_TQDM = False


class TqdmLoggingHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            if _HAVE_TQDM:
                tqdm.tqdm.write(msg)
            else:
                print(msg)
            self.flush()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            self.handleError(record)


def configure_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(message)s",
        handlers=[TqdmLoggingHandler()],
    )
