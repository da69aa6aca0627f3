"""Root logger (copy of ``pfst_tpu/utils/logger.py``; mirrors
``rsiseg/utils/logger.py:7``)."""
import logging
import sys

_initialized = {}


def get_root_logger(log_file=None, log_level=logging.INFO):
    """Get the ``pfst_tpu_torch`` root logger, creating handlers once."""
    logger = logging.getLogger('pfst_tpu_torch')
    if 'pfst_tpu_torch' in _initialized:
        if log_file is not None and not any(
                isinstance(h, logging.FileHandler)
                and h.baseFilename == log_file for h in logger.handlers):
            fh = logging.FileHandler(log_file, 'a')
            fh.setFormatter(_formatter())
            fh.setLevel(log_level)
            logger.addHandler(fh)
        return logger
    logger.setLevel(log_level)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(_formatter())
    sh.setLevel(log_level)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file, 'a')
        fh.setFormatter(_formatter())
        fh.setLevel(log_level)
        logger.addHandler(fh)
    logger.propagate = False
    _initialized['pfst_tpu_torch'] = True
    return logger


def _formatter():
    return logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')


def print_log(msg, logger=None, level=logging.INFO):
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == 'silent':
        pass
    else:
        get_root_logger().log(level, msg)
