"""CLI argument parser (contract: reference manga_translator/args.py — same
flags, same four sub-modes local/ws/shared/config-help). The port runs on
the GPU by default: ``--use-gpu`` is accepted and changes nothing."""
from __future__ import annotations

import argparse
import os
from urllib.parse import unquote


def url_decode(s: str) -> str:
    s = unquote(s)
    if s.startswith('file:///'):
        s = s[len('file://'):]
    return s


def path(string):
    if not string:
        return ''
    s = url_decode(os.path.expanduser(string))
    if not os.path.exists(s):
        raise argparse.ArgumentTypeError(
            f'No such file or directory: "{string}"')
    return s


def file_path(string):
    if not string:
        return ''
    s = url_decode(os.path.expanduser(string))
    if not os.path.exists(s):
        raise argparse.ArgumentTypeError(f'No such file: "{string}"')
    return s


def dir_path(string):
    if not string:
        return ''
    s = url_decode(os.path.expanduser(string))
    if not os.path.exists(s):
        raise argparse.ArgumentTypeError(f'No such directory: "{string}"')
    return s


class HelpFormatter(argparse.HelpFormatter):
    def __init__(self, prog, indent_increment=2, max_help_position=24,
                 width=None):
        super().__init__(prog, 2, 24, None)


def general_parser(g_parser: argparse.ArgumentParser):
    g_parser.add_argument('-v', '--verbose', action='store_true',
                          help='Print debug info and save intermediate '
                               'images in result folder')
    g_parser.add_argument('--attempts', default=0, type=int,
                          help='Retry attempts on encountered error. '
                               '-1 means infinite times.')
    g_parser.add_argument('--ignore-errors', action='store_true',
                          help='Skip image on encountered error.')
    g_parser.add_argument('--model-dir', default=None, type=dir_path,
                          help='Model directory (by default the per-user '
                               'cache directory)')
    g = g_parser.add_mutually_exclusive_group()
    # default None (not False): the CLI always runs on the card, and
    # MangaTranslator reads only an explicit False as "use the CPU"
    g.add_argument('--use-gpu', action='store_true', default=None,
                   help='Run on the GPU (the default; kept for '
                        'compatibility)')
    g.add_argument('--use-gpu-limited', action='store_true',
                   help='Run on the GPU (excluding offline translator)')
    g_parser.add_argument('--font-path', default='', type=file_path,
                          help='Path to font file')
    g_parser.add_argument('--pre-dict', default=None, type=file_path,
                          help='Path to the pre-translation dictionary file')
    g_parser.add_argument('--post-dict', default=None, type=file_path,
                          help='Path to the post-translation dictionary file')
    g_parser.add_argument('--kernel-size', default=3, type=int,
                          help='Set the convolution kernel size of the text '
                               'erasure area to completely clean up text '
                               'residues')
    g_parser.add_argument('--context-size', default=0, type=int,
                          help='Pages of context used for translating the '
                               'current page')
    g_parser.add_argument('--batch-size', default=1, type=int,
                          help='Number of images to process in each batch '
                               'for translation. Default is 1 (no batching)')
    g_parser.add_argument('--batch-concurrent', action='store_true',
                          help='Use concurrent mode for batch translation - '
                               'process each image separately instead of '
                               'merging into large batches.')
    g_parser.add_argument('--disable-memory-optimization',
                          action='store_true',
                          help='Disable automatic memory optimization')
    g_parser.add_argument('--models-ttl', default=0, type=int,
                          help='How long to keep models in memory in seconds '
                               'after last use (0 means forever)')


def reparse(arr: list):
    p = argparse.ArgumentParser(
        prog='manga_translator',
        description='Seamlessly translate mangas into a chosen language',
        formatter_class=HelpFormatter)
    general_parser(p)
    return p.parse_args(arr)


parser = argparse.ArgumentParser(
    prog='manga_translator',
    description='Seamlessly translate mangas into a chosen language',
    formatter_class=HelpFormatter)
general_parser(parser)
subparsers = parser.add_subparsers(dest='mode', required=True,
                                   help='Mode of operation')

parser_batch = subparsers.add_parser('local',
                                     help='Run in batch translation mode')
parser_batch.add_argument('-i', '--input', required=True, type=path,
                          nargs='+', help='Path to an image folder')
parser_batch.add_argument('-o', '--dest', default='', type=str,
                          help='Path to the destination folder for '
                               'translated images')
parser_batch.add_argument('-f', '--format', default=None,
                          help='Output format of the translation.')
parser_batch.add_argument('--overwrite', action='store_true',
                          help='Overwrite already translated images')
parser_batch.add_argument('--skip-no-text', action='store_true',
                          help='Skip image without text '
                               '(Will not be saved).')
parser_batch.add_argument('--use-mtpe', action='store_true',
                          help='Turn on machine translation post editing '
                               '(MTPE) on the command line')
g_batch = parser_batch.add_mutually_exclusive_group()
g_batch.add_argument('--save-text', action='store_true',
                     help='Save extracted text and translations into a '
                          'text file.')
g_batch.add_argument('--load-text', action='store_true',
                     help='Load extracted text and translations from a '
                          'text file.')
g_batch.add_argument('--save-text-file', default='', type=str,
                     help='Like --save-text but with a specified file path.')
parser_batch.add_argument('--prep-manual', action='store_true',
                          help='Prepare for manual typesetting by outputting '
                               'blank, inpainted images plus copies of the '
                               'original for reference')
parser_batch.add_argument('--save-quality', default=100, type=int,
                          help='Quality of saved JPEG image, 0-100')
parser_batch.add_argument('--config-file', default=None, type=str,
                          help='path to the config file')

parser_ws = subparsers.add_parser('ws', help='Run in WebSocket mode')
parser_ws.add_argument('--host', default='127.0.0.1', type=str)
parser_ws.add_argument('--port', default=5003, type=int)
parser_ws.add_argument('--nonce', default=os.getenv('MT_WEB_NONCE') or None,
                       type=str)
parser_ws.add_argument('--ws-url', default='ws://localhost:5000', type=str)

parser_api = subparsers.add_parser('shared', help='Run in API mode')
parser_api.add_argument('--host', default='127.0.0.1', type=str)
parser_api.add_argument('--port', default=5003, type=int)
parser_api.add_argument('--nonce', default=os.getenv('MT_WEB_NONCE') or None,
                        type=str)
parser_api.add_argument('--report', default=None, type=str,
                        help='reports to server to register instance')

subparsers.add_parser('config-help',
                      help='Print help information for config file')
