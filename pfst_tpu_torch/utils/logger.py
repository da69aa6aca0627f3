"""Root logger (copy of ``pfst_tpu/utils/logger.py``; mirrors
``rsiseg/utils/logger.py:7`` and, for the ranks of a process group,
mmcv's ``get_logger``)."""
import logging
import sys

_initialized = {}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def get_root_logger(log_file=None, log_level=logging.INFO):
    """Get the ``pfst_tpu_torch`` root logger, creating handlers once.
    Under a process group, ranks above 0 log at ERROR and write no file,
    as mmseg's logger does."""
    logger = logging.getLogger('pfst_tpu_torch')
    if _rank() > 0:
        log_level, log_file = logging.ERROR, None
        logger.setLevel(log_level)
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
